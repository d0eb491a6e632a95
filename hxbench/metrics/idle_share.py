"""The share of the traced window in which no device operation ran:
1 - busy / window, the busy time (the union of device operations'
intervals) averaged over the cards. %."""


def read(rec):
    if not rec["trace"]["device"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
