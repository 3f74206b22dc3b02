"""Host milliseconds a request spends waiting for its answer and copying it
back: the program's ``pydens.predict.to_host`` spans, over its
``pydens.predict`` spans."""

from portbench.program_spans import ms_a_request


def read(r):
    return ms_a_request(r, "pydens.predict.to_host")
