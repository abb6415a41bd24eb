from rbg_tpu_torch.discovery.env_builder import build_env, leader_address

__all__ = ["build_env", "leader_address"]
