"""Launch-side analysis (port of ``repro.launch``): the roofline ideal."""
