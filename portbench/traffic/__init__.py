"""Traffic: the frozen copy of the speech generator and the corpus draws."""
