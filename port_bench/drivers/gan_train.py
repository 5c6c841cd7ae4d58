"""Training: ``gan_train_step`` on one ``GANState`` for the window, after
its first steps (which the reference follows) and a warm-up."""

from port_bench.harness import training


def measure(record):
    device = record.extra.get('device', 'cuda')
    trained = training.build(record, device)
    training.window(trained, record)
    return trained


def verify(record, trained):
    device = record.extra.get('device', 'cuda')
    checks = training.check(trained, record, device)
    if record.trace:
        record.extra['step_flops'] = training.step_flops(trained, device)
    return checks
