"""Shared by the bound files: the byte size of a dtype as the profiler
names it."""

DTYPE_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "int": 4, "long int": 8, "bool": 1,
               "signed char": 1, "unsigned char": 1}


def elem_bytes(launch, i: int) -> int:
    """Bytes of an element of input ``i``; a list of tensors (no dtype
    recorded) takes the configuration's float size."""
    name = launch["dtypes"][i] if i < len(launch["dtypes"]) else ""
    return DTYPE_BYTES.get(name, launch["float_bytes"])
