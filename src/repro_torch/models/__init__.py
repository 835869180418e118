"""Model pieces of the port: the configuration dataclasses, exact decode
attention and HNTL-KV retrieval attention (the paper's Mode B as
long-context decode).  The transformer around them is not ported yet."""
