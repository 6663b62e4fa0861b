from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedules import make_schedule
