from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                         load_checkpoint, save_checkpoint)
