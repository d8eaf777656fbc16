"""Launch scripts of the port: ``lm_decode`` (prefill + cached greedy
decode of a dense GQA decoder), ``train`` (the LM training launcher) and
the step factories and shape cells it binds (``steps``, ``shapes``)."""
