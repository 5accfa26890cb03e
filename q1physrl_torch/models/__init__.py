"""Policy/value models and action distributions."""

from .distributions import Categorical, GaussianSquashedGaussian
from .import_rllib import (import_policy_params, load_rllib_checkpoint,
                           params_from_jax)
from .mlp import MLP, normc_init
from .policy import ActionDist, Policy, action_dist

__all__ = (
    "Categorical", "GaussianSquashedGaussian",
    "import_policy_params", "load_rllib_checkpoint", "params_from_jax",
    "MLP", "normc_init",
    "ActionDist", "Policy", "action_dist",
)
