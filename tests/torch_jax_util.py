"""Shared helper of the paddle_tpu_torch tests that hold the port against
paddle_tpu (it imports JAX; ``torch_port_util`` does not)."""
import jax
import numpy as np

from paddle_tpu.models import gpt as jg
from paddle_tpu_torch.models import gpt as tg


def scaled_params(cfg_j, seed=3):
    """One JAX ``gpt_init`` as numpy, its block matrices scaled x4 so that
    greedy streams vary from token to token (at init scale they repeat
    one token), and the same tree as the port's CPU params."""
    tree = jax.tree.map(np.asarray, jg.gpt_init(cfg_j, seed=seed))
    blocks = dict(tree["blocks"])
    for k in ("qkv_w", "proj_w", "fc_w", "out_w"):
        blocks[k] = blocks[k] * 4.0
    tree = {**tree, "blocks": blocks}
    return tree, tg.params_from_jax(tree, device="cpu")
