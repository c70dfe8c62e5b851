from repro_torch.ckpt.manager import (DTYPE_NAMES, CheckpointManager,
                                      fs3_backend, named_leaves, pack_named,
                                      read_named, stored_dtype)

__all__ = ["CheckpointManager", "DTYPE_NAMES", "fs3_backend",
           "named_leaves", "pack_named", "read_named", "stored_dtype"]
