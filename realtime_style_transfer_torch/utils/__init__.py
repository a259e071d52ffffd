"""Small helpers without a device: protobuf wire format, summary statistics."""
