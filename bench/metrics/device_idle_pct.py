"""device_idle_pct: the share of a round in which the device is idle, in
%: 1 − (the busy time of the profiler's device pass, the union of its
device operations' intervals) ÷ (the rounds' time; ``harness/trace``).

On one chip the time is that of as many rounds without the profiler, by
the host's clock between two synchronisations: the profiler's own host
work slows a round that the host paces, while the device's operations
take as long.  On several chips a collective's kernel runs until the
last rank arrives, so its busy time depends on the profiled rounds'
pace: there the time is the device pass's own window.  The traced
window's own idle share (the result's ``busy_s`` and ``window_s``)
reads higher in a host-paced cell."""


def read(run):
    t = run.trace
    if not t:
        return None
    window = t["plain_window_s"] if run.chips == 1 else t["window_s"]
    if t["busy_s"] <= 0 or window <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / window)
