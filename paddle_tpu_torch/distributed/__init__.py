"""Counterpart of ``paddle_tpu.distributed``; so far only
:mod:`.fleet.recompute`."""
