"""Command-line tools of the port (``rbg_tpu/cli``): ``gpucheck``, the
one-command hardware check on an NVIDIA GPU, and ``main``, the control
plane's ``validate`` and ``apply``."""
