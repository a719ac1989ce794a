"""How much of Paddle's API the port resolves, against
``tests/ref_api_inventory.json`` (every public name of the reference's
namespaces): each name looked up on the port's matching module.

The port must resolve at least 214 of the 224 names of ``paddle``, and
all of ``paddle.nn`` (109), ``paddle.nn.functional`` (96),
``paddle.vision.models``, ``paddle.vision.ops`` (12),
``paddle.vision.transforms`` (32) and ``paddle.linalg``; and the names it lacks
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
    "paddle": (214, {
        # places, data parallelism, the reader batcher
        "CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "NPUPlace",
        "DataParallel", "batch",
        # static-mode and print toggles, flops
        "disable_signal_handler", "disable_static", "flops",
        "set_printoptions",
    }),
    "paddle.nn": (109, set()),
    "paddle.nn.functional": (96, set()),
    "paddle.vision.models": (25, set()),
    "paddle.vision.ops": (12, set()),
    "paddle.vision.transforms": (32, set()),
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
        "paddle.vision.models": 25, "paddle.vision.ops": 12,
        "paddle.vision.transforms": 32, "paddle.linalg": 16}
