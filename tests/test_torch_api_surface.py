"""How much of Paddle's API the port resolves, against
``tests/ref_api_inventory.json`` (every public name of the reference's
namespaces): each name looked up on the port's matching module.

The port must resolve at least 220 of the 224 names of ``paddle``, and
all of ``paddle.nn`` (109), ``paddle.nn.functional`` (96),
``paddle.vision.models``, ``paddle.vision.ops`` (12),
``paddle.vision.transforms`` (32), ``paddle.linalg``, ``paddle.static``
(43), ``paddle.static.nn`` (40), ``paddle.fluid.layers`` (308),
``paddle.fluid.dygraph`` (61), ``paddle.text`` (9) and
``paddle.distribution`` (4); and the names it lacks must be exactly those
listed here, so a later slice can only shrink the lists (and must shrink
them here when it ports a name). This file imports neither JAX nor
paddle_tpu.

Some names resolve and raise, naming the ROADMAP item that ports them:
``static.save_inference_model``, ``load_inference_model``,
``serialize_program``, ``serialize_persistables``,
``deserialize_program`` and ``deserialize_persistables`` (item 11, the
export format, as ``jit.save`` / ``jit.load``); ``fluid.layers``'
LoD-coupled, op-level beam-search, detection-composition and
parameter-server names raise with their replacements, as the JAX
package's do."""
import importlib
import json
import pathlib

import pytest

INVENTORY = pathlib.Path(__file__).with_name("ref_api_inventory.json")

# namespace -> (least count resolved, the names still missing)
MISSING = {
    "paddle": (220, {
        # data parallelism (item 7)
        "DataParallel",
        # the signal and print toggles, flops
        "disable_signal_handler", "flops", "set_printoptions",
    }),
    "paddle.nn": (109, set()),
    "paddle.nn.functional": (96, set()),
    "paddle.vision.models": (25, set()),
    "paddle.vision.ops": (12, set()),
    "paddle.vision.transforms": (32, set()),
    "paddle.linalg": (16, set()),
    "paddle.static": (43, set()),
    "paddle.static.nn": (40, set()),
    "paddle.fluid.layers": (308, set()),
    "paddle.fluid.dygraph": (61, set()),
    "paddle.text": (9, set()),
    "paddle.distribution": (4, set()),
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
        "paddle.vision.transforms": 32, "paddle.linalg": 16,
        "paddle.static": 43, "paddle.static.nn": 40,
        "paddle.fluid.layers": 308, "paddle.fluid.dygraph": 61,
        "paddle.text": 9, "paddle.distribution": 4}
