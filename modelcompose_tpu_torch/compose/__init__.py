"""Checkpoint composition on the port: reference-layout converters, the
merge of unimodal DAMC checkpoints, and the formats both read and write."""
