"""fluid.profiler (reference fluid/profiler.py) re-exports
``paddle.profiler``, which is not ported yet (ROADMAP.md Queue 1 item
9's remainder): every function raises and says so."""


def _needs_profiler(what):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"fluid.profiler.{what} needs paddle.profiler, which is not "
            f"ported yet (ROADMAP.md Queue 1 item 9's remainder)")

    fn.__name__ = what
    return fn


cuda_profiler = _needs_profiler("cuda_profiler")
npu_profiler = _needs_profiler("npu_profiler")
profiler = _needs_profiler("profiler")
reset_profiler = _needs_profiler("reset_profiler")
start_profiler = _needs_profiler("start_profiler")
stop_profiler = _needs_profiler("stop_profiler")
