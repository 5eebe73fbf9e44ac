"""Training state a node holds (params, m and v as the allocator's
requested bytes grew when they were laid out, plus the step's gradient
bytes that ``TrainStepBundle.stats`` reports), GiB per node."""


def read(r):
    return r.stats["state_bytes_per_node"] / 2 ** 30
