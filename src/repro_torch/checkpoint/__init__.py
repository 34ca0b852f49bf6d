from repro_torch.checkpoint.store import Streamed, latest_step, restore, save

__all__ = ["Streamed", "latest_step", "restore", "save"]
