"""Fault tolerance for training (``repro.distributed``): the
checkpoint-restart driver and the straggler monitor."""
