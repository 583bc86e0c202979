"""Distribution layer: sharding rules (vision serving and LM), fault
tolerance, pipeline parallelism (counterpart of `repro/distributed`)."""
