"""Command-line tools of the port (``rbg_tpu/cli``): ``gpucheck``, the
one-command hardware check on an NVIDIA GPU."""
