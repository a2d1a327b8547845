from . import formats, schema, readers, featurizer, dataset, pipeline, synthetic  # noqa: F401
