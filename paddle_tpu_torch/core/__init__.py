"""Program IR, front end, registry and executor of the port (counterpart
of paddle_tpu/core)."""
