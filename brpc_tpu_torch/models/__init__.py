"""The TransformerLM of the port: serving (``make_decode``, the
generators, ``LMService``) and training (``make_forward``,
``make_train_step``), dense or with MoE blocks (``MoEConfig``)."""

from .moe import MoEConfig
from .transformer_lm import (LMConfig, init_params, make_forward,
                             make_train_step, make_value_and_grad)

__all__ = ["LMConfig", "MoEConfig", "init_params", "make_forward",
           "make_train_step", "make_value_and_grad"]
