// Fast Verilog-literal artifact emitter.
//
// The RTL bring-up flow dumps every weight tensor and every intermediate
// activation of a golden-image run as "<width>'b<binary>" text (reference
// quantisation/utils/save_weights.py:45-155). For a 640x640 image that is
// ~10M formatted lines; the Python writer takes minutes, this emitter
// seconds. Byte-identical output to export/verilog.py's Python writers
// (tests/test_torch_export.py). A copy of the JAX package's emitter.
//
// Built by native/__init__.py on first use (g++ -O2 -shared -fPIC, into
// native/build/) and loaded via ctypes; the Python writer is the fallback.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <string>

namespace {

// bit_converter (reference utils/save_weights.py:45-70): magnitude binary
// with the sign folded into the width prefix; returns overflow count.
int bit_literal(char* out, int64_t value, int k, const char* element,
                int bias_bits) {
    char bits[80];
    uint64_t mag = value < 0 ? (uint64_t)(-value) : (uint64_t)value;
    int n = 0;
    if (mag == 0) {
        bits[n++] = '0';
    } else {
        char tmp[72];
        int t = 0;
        while (mag) { tmp[t++] = '0' + (mag & 1); mag >>= 1; }
        while (t) bits[n++] = tmp[--t];
    }
    bits[n] = 0;

    int width, zeros, overflow = 0;
    if (!strcmp(element, "bias")) {
        width = bias_bits;
        zeros = bias_bits - n;
    } else if (!strcmp(element, "rescale")) {
        width = k;
        zeros = k - n;
    } else {
        width = k - 1;
        zeros = k - n - 1;
    }
    if (zeros < 0) { zeros = 0; overflow = 1; }

    char* p = out;
    if (value < 0 && strcmp(element, "rescale")) *p++ = '-';
    p += sprintf(p, "%d'b", width);
    for (int i = 0; i < zeros; i++) *p++ = '0';
    memcpy(p, bits, n + 1);
    return overflow;
}

}  // namespace

extern "C" {

// pixel[i] = <lit>; // value   grouped per channel with
// "\n//   Channel: c\n\n" headers and a blank line after each channel
// (reference utils/save_weights.py:112-126).
int write_txt_activations(const char* path, const int64_t* arr,
                          int b, int c, int h, int w, int k) {
    FILE* f = fopen(path, "w");
    if (!f) return -1;
    char lit[128];
    int overflows = 0;
    long i = 0;
    for (int bi = 0; bi < b; bi++) {
        for (int ci = 0; ci < c; ci++) {
            fprintf(f, "\n//   Channel: %d\n\n", ci);
            const int64_t* base = arr + (((long)bi * c + ci) * h * w);
            for (long px = 0; px < (long)h * w; px++) {
                overflows += bit_literal(lit, base[px], k, "activ", 18);
                fprintf(f, "pixel[%ld] = %s; // %lld\n", i++, lit,
                        (long long)base[px]);
            }
            fputs("\n", f);
        }
    }
    fclose(f);
    return overflows;
}

// weight[i] = ...; per out-channel "Batch" headers, then weight_bias[i]
// in 18-bit budget (reference utils/save_weights.py:90-109).
int write_txt_weights(const char* path, const int64_t* wq,
                      int o, int c, int kh, int kw,
                      const int64_t* bias, long bias_len, int k,
                      int bias_bits) {
    FILE* f = fopen(path, "w");
    if (!f) return -1;
    char lit[128];
    int overflows = 0;
    long i = 0;
    for (int oi = 0; oi < o; oi++) {
        fprintf(f, "\n//   Batch: %d\n\n", oi);
        for (int ci = 0; ci < c; ci++) {
            const int64_t* base = wq + ((((long)oi * c + ci) * kh) * kw);
            for (int px = 0; px < kh * kw; px++) {
                overflows += bit_literal(lit, base[px], k, "weight", bias_bits);
                fprintf(f, "weight[%ld] = %s; // %lld\n", i++, lit,
                        (long long)base[px]);
            }
            fputs("\n", f);
        }
    }
    fputs("\n\n", f);
    i = 0;
    for (long bi = 0; bi < bias_len; bi++) {
        overflows += bit_literal(lit, bias[bi], k, "bias", bias_bits);
        fprintf(f, "weight_bias[%ld] = %s; // %lld\n", i++, lit,
                (long long)bias[bi]);
    }
    fclose(f);
    return overflows;
}

}  // extern "C"
