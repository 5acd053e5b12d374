"""Engine layer (`core/nsga2.py::_GraphChunk.run`), tree search: device
milliseconds of a chunk call's eager draws into the buffers its CUDA graph
reads, in the traced stretch: the mean device time of a random draw's
kernel, times the draws (the counter `nsga2.draws`) over the calls of the
span `nsga2.chunk.draw`."""
from perfbench import spans


def read(record):
    return spans.draw_device_ms(record)
