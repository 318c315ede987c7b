"""Image post-processing and random-weight builders."""
