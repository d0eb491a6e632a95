"""tfevents summaries without TensorFlow (counterpart of ``hemx.summaries``)."""
