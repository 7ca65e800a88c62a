"""Entry points of the port that launch work: LM serving (``serve``),
training (``train``), and the dry-run over one H100 with its roofline and
report (``dryrun``, ``cost_analysis``, ``roofline``, ``report``)."""
