"""Distributed entry points: worker process groups and the sharded LAQ
training step on ``torch.distributed``."""
