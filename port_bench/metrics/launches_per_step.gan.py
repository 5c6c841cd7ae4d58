"""Device operations (kernels, copies, sets) per GAN step over the
profiled steps."""


def read(record):
    if record.device is None or not record.extra.get('traced_steps'):
        return None
    return len(record.device.ops) / record.extra['traced_steps']
