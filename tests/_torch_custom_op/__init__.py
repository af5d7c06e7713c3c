"""A custom op with a hand-written CUDA kernel, registered through
``paddle_tpu_torch.utils.register_op`` (the port's counterpart of the
Pallas ``twoxplus1`` fixture of ``tests/test_custom_op.py``)."""
