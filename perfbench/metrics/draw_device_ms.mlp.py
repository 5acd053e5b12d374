"""Engine layer, printed-MLP search: as `draw_device_ms`."""
from perfbench import spans


def read(record):
    return spans.draw_device_ms(record)
