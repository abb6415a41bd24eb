from rbg_tpu_torch.inplace.update import image_only_diff, try_inplace_update

__all__ = ["image_only_diff", "try_inplace_update"]
