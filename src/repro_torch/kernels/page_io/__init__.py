"""Page copies: land page tiles in the physical KV pool in place, and move
pages between the pool and its pinned host twin (the substrate's
streams)."""
