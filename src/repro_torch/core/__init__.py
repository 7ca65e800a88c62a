"""Core index pieces of the port: k-means, PQ, fast-scan LUTs, lists, IVF."""
