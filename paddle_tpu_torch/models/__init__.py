"""Models of the port: the GPT decoder (dense and MoE, serving and
training)."""
from .gpt import (GPTConfig, bert_base_config, gpt_1p3b, gpt_decode_step,
                  gpt_decode_step_paged, gpt_forward, gpt_init, gpt_nano,
                  gpt_prefill, gpt_prefill_chunk, gpt_small, gpt_tiny,
                  params_from_jax)

__all__ = ["GPTConfig", "bert_base_config", "gpt_1p3b", "gpt_decode_step",
           "gpt_decode_step_paged", "gpt_forward", "gpt_init", "gpt_nano",
           "gpt_prefill", "gpt_prefill_chunk", "gpt_small", "gpt_tiny",
           "params_from_jax"]
