"""AdamW's step and its gradient norm over a whole list of leaves: the
CUDA kernels, the plan of their launches, and the plain loop they
replace."""
