"""Paged serving engine, block allocator, prefix cache and stats schema."""
