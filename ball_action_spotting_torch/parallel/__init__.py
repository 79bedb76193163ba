"""Running across devices (port of the JAX package's ``parallel/``):
``mesh`` lays devices out as a (data, model) grid for inference in one
process; ``multihost`` wraps ``torch.distributed`` for training, one process
per device."""
