"""Checkpoint porting: the reference's PyTorch ``.pth`` state dicts -> the
port's modules (counterpart of ``ccvs_tpu/port``)."""
