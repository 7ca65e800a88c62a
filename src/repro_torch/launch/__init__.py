"""Entry points of the port that launch work: LM serving (``serve``)."""
