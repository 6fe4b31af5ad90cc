from ust_run_tpu_torch.semisup.state import (TrainState,  # noqa: F401
                                             create_train_state, reset_epoch)
from ust_run_tpu_torch.semisup.step import HyperParams, step_fn  # noqa: F401
