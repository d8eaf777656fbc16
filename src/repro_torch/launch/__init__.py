"""Launch scripts of the port: ``lm_decode`` (prefill + cached greedy
decode of a dense GQA decoder)."""
