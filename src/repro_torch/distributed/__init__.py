"""Vision sharding rules on torch.distributed (the vision part of
`repro/distributed/sharding.py`)."""
