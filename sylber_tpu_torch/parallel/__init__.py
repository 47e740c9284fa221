"""Data, tensor and fully sharded parallelism over ``torch.distributed``."""
