// Native trace generator: executes a zkVM program and emits the 28-column
// execution trace directly as f128 limb arrays (uint32 x 8, little-endian
// 16-bit limbs) ready for device upload.
//
// This is the TPU build's counterpart of the reference's Rust VM runtime
// (vm/src/processor/*, SURVEY.md C5-C9): trace generation is inherently
// clk-sequential, so it runs on the host CPU in native code (~10M ops/s)
// while the prover consumes the result on the accelerator.  Semantics match
// zkvm/processor/golden.py exactly (tested against it).
//
// Build: g++ -O3 -shared -fPIC trace_gen.cpp -o libtrace_gen.so

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;

// p = 2^128 - 45*2^40 + 1
static const u64 EPS = (45ULL << 40) - 1;  // 2^128 mod p (46 bits)
static const u128 P = (u128)0 - (u128)EPS;  // 2^128 - eps == p

static inline u128 add_mod(u128 a, u128 b) {
    u128 r = a + b;
    if (r < a) r += EPS;  // wrapped past 2^128 == +eps (mod p)
    if (r >= P) r -= P;
    return r;
}

static inline u128 sub_mod(u128 a, u128 b) {
    return (a >= b) ? a - b : a + (P - b);
}

static inline void mul128(u128 a, u128 b, u128 &hi, u128 &lo) {
    u64 a0 = (u64)a, a1 = (u64)(a >> 64), b0 = (u64)b, b1 = (u64)(b >> 64);
    u128 p00 = (u128)a0 * b0, p01 = (u128)a0 * b1;
    u128 p10 = (u128)a1 * b0, p11 = (u128)a1 * b1;
    u128 mid = p01 + p10;
    u128 carry_mid = (mid < p01) ? ((u128)1 << 64) : 0;
    lo = p00 + (mid << 64);
    u128 carry_lo = (lo < p00) ? 1 : 0;
    hi = p11 + (mid >> 64) + carry_mid + carry_lo;
}

static inline u128 mul_mod(u128 a, u128 b) {
    u128 hi, lo;
    mul128(a, b, hi, lo);
    while (hi) {
        u128 h2, l2;
        mul128(hi, (u128)EPS, h2, l2);
        u128 l3 = l2 + lo;
        if (l3 < l2) h2 += 1;
        hi = h2;
        lo = l3;
    }
    if (lo >= P) lo -= P;
    return lo;
}

static u128 pow_mod(u128 a, u128 e) {
    u128 r = 1;
    while (e) {
        if (e & 1) r = mul_mod(r, a);
        a = mul_mod(a, a);
        e >>= 1;
    }
    return r;
}

// ---------------------------------------------------------------------------
// Rescue-Prime (crypto/src/rescue.rs constants; see zkvm/hash/rescue.py)
// ---------------------------------------------------------------------------

static u128 INV_ALPHA = 0;  // loaded with the other protocol constants
static u128 MDS[16];
static u128 INV_MDS_[16];
static u128 ARK[16][8];
static int constants_ready = 0;

extern "C" void zkvm_load_constants(const u32 *mds, const u32 *inv_mds,
                                    const u32 *ark, const u32 *inv_alpha) {
    // each element arrives as 8 little-endian 16-bit limbs in uint32 slots
    auto load = [](const u32 *src) {
        u128 v = 0;
        for (int i = 7; i >= 0; --i) v = (v << 16) | (u128)(src[i] & 0xFFFF);
        return v;
    };
    for (int i = 0; i < 16; ++i) MDS[i] = load(mds + 8 * i);
    for (int i = 0; i < 16; ++i) INV_MDS_[i] = load(inv_mds + 8 * i);
    for (int i = 0; i < 16; ++i)
        for (int j = 0; j < 8; ++j) ARK[i][j] = load(ark + 8 * (8 * i + j));
    INV_ALPHA = load(inv_alpha);
    constants_ready = 1;
}

static void apply_mds(u128 *s) {
    u128 out[4];
    for (int i = 0; i < 4; ++i) {
        u128 acc = 0;
        for (int j = 0; j < 4; ++j) acc = add_mod(acc, mul_mod(MDS[4 * i + j], s[j]));
        out[i] = acc;
    }
    memcpy(s, out, sizeof(out));
}

static void rescue_round(u128 *state, u8 op_code, u8 op_value, u64 step) {
    const u128 *ark = ARK[step % 16];
    for (int i = 0; i < 4; ++i) state[i] = mul_mod(mul_mod(state[i], state[i]), state[i]);
    apply_mds(state);
    for (int i = 0; i < 4; ++i) state[i] = add_mod(state[i], ark[i]);
    state[0] = add_mod(state[0], (u128)op_code);
    state[1] = add_mod(state[1], (u128)op_value);
    for (int i = 0; i < 4; ++i) state[i] = pow_mod(state[i], INV_ALPHA);
    apply_mds(state);
    for (int i = 0; i < 4; ++i) state[i] = add_mod(state[i], ark[4 + i]);
}

// ---------------------------------------------------------------------------
// trace generation
// ---------------------------------------------------------------------------

static inline void store_limbs(u32 *dst, u128 v) {
    for (int i = 0; i < 8; ++i) {
        dst[i] = (u32)(v & 0xFFFF);
        v >>= 16;
    }
}

// opcodes (vm/src/processor/opcodes.rs)
enum {
    OP_NOOP = 0x00, OP_PUSH = 0x10, OP_READ = 0x11, OP_READ2 = 0x12,
    OP_ADD = 0x08, OP_MUL = 0x09, OP_SADD = 0x0A, OP_SMUL = 0x0C,
    OP_ADD2 = 0x0B,
};

// error codes
enum {
    ERR_OK = 0, ERR_UNDERFLOW = 1, ERR_OVERFLOW = 2, ERR_EMPTY_INPUTS = 3,
    ERR_BAD_OPCODE = 4, ERR_HASH_STEP = 5, ERR_NOT_READY = 6,
};

// Program hash: absorb every (op_code, op_value) through the sponge
// (crypto/src/rescue.rs:46-59 semantics); digest = (state[0], state[1]).
extern "C" int zkvm_program_hash(const u8 *op_codes, const u8 *op_values,
                                 u64 n_ops, u32 *digest /* 2*8 u32 */) {
    if (!constants_ready) return ERR_NOT_READY;
    u128 state[4] = {0, 0, 0, 0};
    for (u64 step = 0; step < n_ops; ++step) {
        if (step % 16 < 14) {
            rescue_round(state, op_codes[step], op_values[step], step);
        } else {
            state[2] = 0;
            state[3] = 0;
        }
    }
    for (int i = 0; i < 2; ++i) {
        u128 v = state[i];
        for (int l = 0; l < 8; ++l) {
            digest[i * 8 + l] = (u32)(v & 0xFFFF);
            v >>= 16;
        }
    }
    return ERR_OK;
}

// out: uint32 buffer shaped (28, trace_length, 8) C-order.
// secret tape: n_secret ciphertexts of lwe_size u128 limb groups (flattened,
// each element 8 uint32 limbs).
extern "C" int zkvm_run_trace(
    const u8 *op_codes, const u8 *op_values, u64 n_ops,
    const u8 *pub_tape, u64 n_pub,
    const u32 *secret_tape, u64 n_secret, u64 lwe_size,
    u64 delta,
    u64 trace_length,
    u32 *out, u32 *outputs /* 16*8 u32 */) {
    if (!constants_ready) return ERR_NOT_READY;

    const u64 T = trace_length;
    u32 *col = out;  // helper: column c row r limb l at out[(c*T + r)*8 + l]
    auto store = [&](u64 c, u64 r, u128 v) { store_limbs(col + (c * T + r) * 8, v); };

    u128 stack[16] = {0};
    u128 prev[16] = {0};
    u128 sponge[4] = {0};
    u64 depth = 0;
    u64 pub_pos = 0, sec_pos = 0;

    // row 0: initial state (all zero columns except clk handled in loop)
    for (int c = 0; c < 28; ++c) store(c, 0, 0);

    for (u64 clk = 1; clk <= n_ops; ++clk) {
        u8 code = op_codes[clk - 1];
        u8 value = op_values[clk - 1];
        memcpy(prev, stack, sizeof(stack));

        switch (code) {
            case OP_NOOP:
                break;
            case OP_PUSH: {
                if (++depth > 16) return ERR_OVERFLOW;
                for (u64 i = depth - 1; i >= 1; --i) stack[i] = prev[i - 1];
                stack[0] = (u128)value;
                break;
            }
            case OP_READ: {
                if (++depth > 16) return ERR_OVERFLOW;
                if (pub_pos >= n_pub) return ERR_EMPTY_INPUTS;
                for (u64 i = depth - 1; i >= 1; --i) stack[i] = prev[i - 1];
                stack[0] = (u128)pub_tape[pub_pos++];
                break;
            }
            case OP_READ2: {
                if (sec_pos >= n_secret) return ERR_EMPTY_INPUTS;
                depth += lwe_size;
                if (depth > 16) return ERR_OVERFLOW;
                for (u64 i = depth - 1; i >= lwe_size; --i) stack[i] = prev[i - lwe_size];
                const u32 *ct = secret_tape + sec_pos * lwe_size * 8;
                for (u64 i = 0; i < lwe_size; ++i) {
                    u128 v = 0;
                    for (int l = 7; l >= 0; --l) v = (v << 16) | (u128)(ct[i * 8 + l] & 0xFFFF);
                    stack[i] = v;
                }
                sec_pos++;
                break;
            }
            case OP_ADD: case OP_MUL: {
                if (depth < 2) return ERR_UNDERFLOW;
                u128 r = (code == OP_ADD) ? add_mod(prev[0], prev[1])
                                          : mul_mod(prev[0], prev[1]);
                for (u64 i = 1; i + 1 < depth; ++i) stack[i] = prev[i + 1];
                stack[depth - 1] = 0;
                stack[0] = r;
                depth -= 1;
                break;
            }
            case OP_SADD: case OP_SMUL: {
                if (depth < lwe_size + 1) return ERR_UNDERFLOW;
                u128 res[16];
                if (code == OP_SADD) {
                    for (u64 i = 0; i < lwe_size; ++i) res[i] = prev[1 + i];
                    res[lwe_size - 1] =
                        add_mod(res[lwe_size - 1], mul_mod((u128)delta, prev[0]));
                } else {
                    for (u64 i = 0; i < lwe_size; ++i)
                        res[i] = mul_mod(prev[1 + i], prev[0]);
                }
                for (u64 i = lwe_size; i + 1 < depth; ++i) stack[i] = prev[i + 1];
                stack[depth - 1] = 0;
                for (u64 i = 0; i < lwe_size; ++i) stack[i] = res[i];
                depth -= 1;
                break;
            }
            case OP_ADD2: {
                if (depth < 2 * lwe_size) return ERR_UNDERFLOW;
                u128 res[16];
                for (u64 i = 0; i < lwe_size; ++i)
                    res[i] = add_mod(prev[i], prev[i + lwe_size]);
                for (u64 i = 2 * lwe_size; i < depth; ++i) stack[i - lwe_size] = prev[i];
                for (u64 i = depth - lwe_size; i < depth; ++i) stack[i] = 0;
                for (u64 i = 0; i < lwe_size; ++i) stack[i] = res[i];
                depth -= lwe_size;
                break;
            }
            default:
                return ERR_BAD_OPCODE;
        }

        // decoder bits at row clk-1 (columns 1..5)
        for (int b = 0; b < 5; ++b) store(1 + b, clk - 1, (code >> b) & 1);
        // chiplet: hash flag + sponge
        u64 step = clk - 1;
        if (step % 16 < 14) {
            rescue_round(sponge, code, value, step);
        } else {
            if (code != OP_NOOP) return ERR_HASH_STEP;
            sponge[2] = 0;
            sponge[3] = 0;
        }
        store(6, clk - 1, 1);
        for (int l = 0; l < 4; ++l) store(7 + l, clk, sponge[l]);
        store(11, clk, (u128)depth);
        for (int r = 0; r < 16; ++r) store(12 + r, clk, stack[r]);
    }

    // outputs = final stack state
    for (int r = 0; r < 16; ++r) store_limbs(outputs + r * 8, stack[r]);

    // padding
    for (u64 r = 0; r < T; ++r) store(0, r, (u128)r);  // clk column
    for (u64 r = n_ops; r < T; ++r) {
        for (int b = 0; b < 5; ++b) store(1 + b, r, 0);
        store(6, r, 0);
    }
    for (u64 r = n_ops + 1; r < T; ++r) {
        for (int l = 0; l < 4; ++l) store(7 + l, r, sponge[l]);
        store(11, r, (u128)depth);
        for (int s = 0; s < 16; ++s) store(12 + s, r, stack[s]);
    }
    return ERR_OK;
}
