"""The mesh (data, model, space) and what each axis shards."""
