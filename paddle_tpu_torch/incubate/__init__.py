"""Port of ``paddle_tpu/incubate``: so far only the fused norms of
``incubate.nn.functional``."""
