"""Entry points of the port that launch work: LM serving (``serve``),
training (``train``), the dry-run over one H100 and over the reference's
pod meshes with its roofline and report (``dryrun``, ``cost_analysis``,
``roofline``, ``report``), and the meshes and logical-axis sharding rules
(``mesh``, ``sharding``)."""
