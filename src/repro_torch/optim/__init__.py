from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup
from repro_torch.optim.compression import (ErrorFeedbackState, ef_init,
                                           ef_int8_compress,
                                           ef_int8_decompress)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "linear_warmup", "ErrorFeedbackState",
           "ef_init", "ef_int8_compress", "ef_int8_decompress"]
