"""How much of Paddle's API the port resolves, against
``tests/ref_api_inventory.json`` (every public name of the reference's
namespaces): each name looked up on the port's matching module.

The port must resolve at least 203 of the 224 names of ``paddle``, 83 of
109 in ``paddle.nn``, 76 of 96 in ``paddle.nn.functional``, and all of
``paddle.vision.models`` and ``paddle.linalg``; and the names it lacks
must be exactly those listed here, so a later slice can only shrink the
lists (and must shrink them here when it ports a name). This file
imports neither JAX nor paddle_tpu."""
import importlib
import json
import pathlib

import pytest

INVENTORY = pathlib.Path(__file__).with_name("ref_api_inventory.json")

# namespace -> (least count resolved, the names still missing)
MISSING = {
    "paddle": (203, {
        # places, data parallelism, the reader batcher
        "CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "NPUPlace",
        "DataParallel", "batch",
        # tensor/random.py (Queue 1 item 8 step 1d)
        "bernoulli", "multinomial", "normal", "rand", "randint", "randn",
        "randperm", "standard_normal", "uniform",
        # static-mode, rng-state and print toggles, flops
        "disable_signal_handler", "disable_static", "flops",
        "get_cuda_rng_state", "set_cuda_rng_state", "set_printoptions",
    }),
    "paddle.nn": (83, {
        # step 1c: transposed convs and the other norms
        "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
        "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
        "LocalResponseNorm", "SpectralNorm",
        # step 1d: RNNs and decoding
        "BiRNN", "GRU", "GRUCell", "LSTM", "LSTMCell", "RNN", "RNNCellBase",
        "SimpleRNN", "SimpleRNNCell", "BeamSearchDecoder", "dynamic_decode",
        "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
        # step 1e: the remaining losses
        "CTCLoss", "HSigmoidLoss", "MarginRankingLoss",
    }),
    "paddle.nn.functional": (76, {
        "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
        "instance_norm", "local_response_norm", "max_unpool2d",
        "diag_embed", "gather_tree", "temporal_shift", "sequence_mask",
        "sparse_attention",
        "ctc_loss", "dice_loss", "hsigmoid_loss", "log_loss",
        "margin_cross_entropy", "margin_ranking_loss", "npair_loss",
        "sigmoid_focal_loss", "softmax_with_cross_entropy",
    }),
    "paddle.vision.models": (25, set()),
    "paddle.linalg": (16, set()),
}


def _inventory():
    return json.loads(INVENTORY.read_text())


@pytest.mark.parametrize("namespace", sorted(MISSING))
def test_port_resolves_the_namespace(namespace):
    names = _inventory()[namespace]
    module = importlib.import_module(
        namespace.replace("paddle", "paddle_tpu_torch", 1))
    missing = {n for n in names if not hasattr(module, n)}
    least, listed = MISSING[namespace]
    assert len(names) - len(missing) >= least, sorted(missing)
    assert missing == listed, (sorted(missing - listed),
                               sorted(listed - missing))


def test_inventory_counts_are_the_reference_surface():
    inv = _inventory()
    assert {k: len(inv[k]) for k in MISSING} == {
        "paddle": 224, "paddle.nn": 109, "paddle.nn.functional": 96,
        "paddle.vision.models": 25, "paddle.linalg": 16}
