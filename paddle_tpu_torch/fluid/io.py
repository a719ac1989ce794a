"""fluid.io (reference fluid/io.py): the 1.x dirname-based persistables
pair over ``static.save`` / ``static.load``. The inference pair needs
the export format, not ported yet (ROADMAP.md Queue 1 item 11): it
raises, as ``static.save_inference_model`` does."""
from __future__ import annotations

import os

from ..framework.io import load, save  # noqa: F401


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, **kwargs):
    from ..static import save_inference_model as _save

    _save(os.path.join(dirname, "model"), feeded_var_names, target_vars,
          executor)


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, **kwargs):
    from ..static import load_inference_model as _load

    return _load(os.path.join(dirname, "model"), executor)


def save_persistables(executor, dirname, main_program=None, filename=None):
    from ..static import default_main_program
    from ..static import save as _save

    os.makedirs(dirname, exist_ok=True)
    _save(main_program or default_main_program(),
          os.path.join(dirname, "persist"))


def load_persistables(executor, dirname, main_program=None, filename=None):
    from ..static import default_main_program
    from ..static import load as _loadp

    _loadp(main_program or default_main_program(),
           os.path.join(dirname, "persist"))
