"""Multi-device execution on torch.distributed (``sharding``) and the
ranks' side of a spawned run (``spmd``)."""
