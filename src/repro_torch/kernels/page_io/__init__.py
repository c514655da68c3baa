"""Page writer: land page tiles in the physical KV pool in place."""
