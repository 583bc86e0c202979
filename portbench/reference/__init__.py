"""Plain float32 PyTorch references of the benchmark's configurations, one
module per model family.  They import nothing of the program."""
