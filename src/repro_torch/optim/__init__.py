from .adamw import (AdamWState, adamw_init, adamw_update, cosine_lr,
                    global_norm)
from .compression import (compress_grads, decompress_grads,
                          init_error_feedback)
