"""The port's benchmark: ``python3 portbench/run.py --workload NAME ...``
(see ``README.md``)."""
