"""The ported layers of ``paddle_tpu.nn.layer``."""
