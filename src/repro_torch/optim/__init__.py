from repro_torch.optim.clip import (clip_by_global_norm, clip_scale, clip_to_norm, global_norm,
                                    scaled)
from repro_torch.optim.optimizers import Optimizer, adafactor, adamw, get_optimizer, sgd_momentum
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine
