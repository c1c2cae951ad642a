"""Entry points: worker process groups and the sharded LAQ training step
on ``torch.distributed``, the serving steps, and the publisher that feeds
a replica fleet."""
