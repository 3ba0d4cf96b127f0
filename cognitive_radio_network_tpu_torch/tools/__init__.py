"""Operator tools: the headless spectrum analyzer (:mod:`.spectrum_analyzer`)."""
