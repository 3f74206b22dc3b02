"""The share of the cell's time in which no operation ran on the device:
one untraced unit's seconds (``Reading.unit_s``) less the device's busy
time a unit in the traced window, over the former.  One reader for every
``device_idle_share.<kind>`` metric."""


def read(r):
    if not r.units or not r.unit_s:
        return None
    return 100 * (1 - r.busy_s / r.units / r.unit_s)
