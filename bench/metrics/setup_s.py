"""setup_s: seconds from the process's start to the window's (imports,
inputs and weights made on the card, the program's set-up, the first
steps that the correctness check follows, warm-up; the build too in a
checkout's first run)."""


def read(rec):
    return rec.setup_s
