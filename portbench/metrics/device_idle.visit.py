"""The device's idle share [%] over the visit window: device_idle.ccd's
reading (1 - busy / wall, busy the union of device operations on every
stream)."""
from portbench import harness

read = harness.metric_reader("device_idle.ccd")
