/* C interface of the GGUF reader (gguf.cpp), loaded from Python with ctypes
 * (native/__init__.py). The GGUF declarations of the JAX package's native
 * header, copied. */
#ifndef LSOT_TORCH_GGUF_H
#define LSOT_TORCH_GGUF_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Tensor dtypes (GGML type ids as stored in GGUF). */
#define LSOT_GGUF_F32 0
#define LSOT_GGUF_F16 1
#define LSOT_GGUF_Q4_0 2
#define LSOT_GGUF_Q8_0 8
#define LSOT_GGUF_Q4_K 12
#define LSOT_GGUF_Q5_K 13
#define LSOT_GGUF_Q6_K 14

void *lsot_gguf_open(const char *path); /* NULL on error (see last_error) */
void lsot_gguf_close(void *h);
int32_t lsot_gguf_n_tensors(void *h);
const char *lsot_gguf_tensor_name(void *h, int32_t i);
int32_t lsot_gguf_tensor_ndim(void *h, int32_t i);
/* Dim d in GGUF order: d=0 is the innermost/fastest-varying axis. */
uint64_t lsot_gguf_tensor_dim(void *h, int32_t i, int32_t d);
int32_t lsot_gguf_tensor_dtype(void *h, int32_t i);
uint64_t lsot_gguf_tensor_nelems(void *h, int32_t i);
/* Dequantize tensor i into out (f32, memory order). 0 on success. */
int32_t lsot_gguf_read_f32(void *h, int32_t i, float *out, uint64_t cap);
/* Metadata: returns NULL / 0 when the key is absent or of another type.
 * All integer/float scalar types surface through meta_f64. */
const char *lsot_gguf_meta_str(void *h, const char *key);
int32_t lsot_gguf_meta_f64(void *h, const char *key, double *out);
const char *lsot_gguf_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* LSOT_TORCH_GGUF_H */
