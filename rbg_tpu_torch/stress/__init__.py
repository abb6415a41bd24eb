"""Serving-plane stress drills (``rbg_tpu/stress/harness.py``'s overload,
kvstream, prefixcache and partition scenarios) on the port's engine,
transfer plane and chaos plane. ``python -m rbg_tpu_torch.stress.harness
--scenario ...`` runs one."""
