"""Hand-written Hopper kernels for ViTA's hot spots, each beside its plain
PyTorch version (`ref`).  `ops` is the device-dispatching surface the
executor calls; importing any module here builds nothing — kernels are
compiled from ``../csrc`` at first launch (`build`)."""
