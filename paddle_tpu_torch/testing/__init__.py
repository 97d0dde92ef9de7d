"""Testing helpers of the port (port of ``paddle_tpu/testing/``)."""
