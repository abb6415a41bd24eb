"""Framework-free utilities of the port (own copies of ``rbg_tpu/utils``
modules it needs: ``locktrace``)."""
