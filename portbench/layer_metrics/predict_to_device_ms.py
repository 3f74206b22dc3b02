"""Host milliseconds a request spends copying its points to the card: the
program's ``pydens.predict.to_device`` spans, over its ``pydens.predict``
spans."""

from portbench.program_spans import ms_a_request


def read(r):
    return ms_a_request(r, "pydens.predict.to_device")
