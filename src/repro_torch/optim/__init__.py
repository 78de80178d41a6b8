from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw, clip_by_global_norm,
                                          clip_to_norm, get_optimizer, global_norm,
                                          sgd_momentum)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine
