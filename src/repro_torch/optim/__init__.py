from repro_torch.optim.adamw import (OptConfig, adamw_update,  # noqa: F401
                                     global_norm, init_opt_state,
                                     lr_schedule, opt_state_from_jax)
from repro_torch.optim.compression import (compress_int8,  # noqa: F401
                                           decompress_int8)
