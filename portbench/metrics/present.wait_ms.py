"""Milliseconds a frame in which the host waited for the previous frame's
copy to the host: the durations of the program's kani.present.wait spans
(runtime/loop._Presenter.collect) over the frames."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, "kani.present.wait")
