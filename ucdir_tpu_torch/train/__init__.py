"""Training: optimizers, the EMA shadow and the train step. Counterpart of
`ucdir_tpu/train/`."""
from ucdir_tpu_torch.train.optim import make_optimizer
from ucdir_tpu_torch.train.state import TrainState, create_train_state
from ucdir_tpu_torch.train.step import step_loss, train_step
