"""setup_s: process start to the first timed unit (host clock): import,
kernel load, problem build, warm-up."""


def read(record):
    return record.get("setup_s")
