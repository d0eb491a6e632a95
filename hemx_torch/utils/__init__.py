"""Host-side helpers (counterpart of ``hemx.utils``)."""
