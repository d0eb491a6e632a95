"""The whole train call's share of the cards' peak: the configuration's
operations per call (``hxbench/flops/<config>.py``) times the calls of the
traced run's window, over the window's wall time, over the peak of the
arithmetic the configuration runs (``peak`` in its file, from
``hxbench/peaks.json``) times the cards. %."""


def read(rec):
    if rec["platform"] != "gpu":
        return None
    flops = rec["flops"].per_call(rec["config"], rec["traffic"])
    peak = rec["peaks"][rec["config"]["peak"]] * 1e12 * rec["chips"]
    return 100.0 * flops * rec["calls"] / rec["wall_s"] / peak
