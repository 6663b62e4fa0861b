from repro_torch.train.step import (init_opt_state, make_grad_fn,
                                    make_loss_fn, make_train_step)
from repro_torch.train.trainer import Trainer
