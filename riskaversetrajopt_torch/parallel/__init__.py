"""Sample-parallel and batch-parallel runs on torch.distributed."""
