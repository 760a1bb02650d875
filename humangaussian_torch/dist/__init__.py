from humangaussian_torch.dist.parallel import (
    make_dp_train_step,
    multihost_init,
)

__all__ = ["make_dp_train_step", "multihost_init"]
