"""Carry checkpoints in the reference's npz layout (:mod:`.ckpt`)."""
