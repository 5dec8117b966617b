"""The system under test, one module a model family: each builds the
port's micro-batching service from a configuration, a traffic file, a
state dict and SMPL arrays. Only these modules import the port."""
