"""Policy/value models and action distributions."""

from .distributions import Categorical, GaussianSquashedGaussian
from .export_rllib import export_policy_params
from .import_rllib import (adam_state_from_jax, import_policy_params,
                           load_rllib_checkpoint, params_from_jax,
                           population_adam_state_from_jax,
                           population_params_from_jax)
from .mlp import MLP, normc_init
from .policy import ActionDist, Policy, StackedPolicy, action_dist

__all__ = (
    "Categorical", "GaussianSquashedGaussian",
    "export_policy_params", "import_policy_params", "load_rllib_checkpoint",
    "params_from_jax", "adam_state_from_jax", "population_params_from_jax",
    "population_adam_state_from_jax",
    "MLP", "normc_init",
    "ActionDist", "Policy", "StackedPolicy", "action_dist",
)
