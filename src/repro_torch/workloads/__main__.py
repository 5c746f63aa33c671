from repro_torch.workloads.cli import main

main()
