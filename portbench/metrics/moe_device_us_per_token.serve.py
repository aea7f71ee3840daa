"""Device microseconds of one token's pass through one MoE layer in
serving: the device time between the markers around each ``moe_mlp`` call
of the stretch, over the tokens those calls took (each layer's call counts
its tokens once; every slot of a decode step is a token)."""


def read(record):
    st = record.get("stretch") or {}
    device = st.get("range_device_s", {}).get("moe_mlp")
    tokens = st.get("range_tokens", {}).get("moe_mlp")
    if record.get("kind") != "serve" or not device or not tokens:
        return None
    return device / tokens * 1e6
