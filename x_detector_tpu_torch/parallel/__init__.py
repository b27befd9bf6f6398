"""Data parallelism over ``torch.distributed`` process groups."""
