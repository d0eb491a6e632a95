"""The most device memory allocated during the window, on the fullest card
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start). GiB."""


def read(rec):
    if rec["platform"] != "gpu":
        return None
    return rec["window_peak_bytes"] / 2 ** 30
