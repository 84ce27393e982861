"""The device: the share of the traced window, in %, in which no kernel,
memcpy or memset ran on the card."""


def read(run):
    if run.window_s <= 0 or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
