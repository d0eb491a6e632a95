"""Model plugins (counterpart of ``hemx.models``); only ``iwgan`` so far."""
