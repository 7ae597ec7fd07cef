/* C interface of the text library: the BPE encoder (bpe.cpp) and the CSV
 * schema scanner (csvscan.cpp), loaded from Python with ctypes
 * (native/__init__.py). The BPE and CSV declarations of the JAX package's
 * native header, copied. */
#ifndef LSOT_TORCH_TEXT_H
#define LSOT_TORCH_TEXT_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- BPE encoder ---- */

/* pairs: flat [a0, b0, a1, b1, ...]; merging pair i yields id base + i where
 * base = n_special + 256. Returns an opaque handle (never NULL). */
void *lsot_bpe_new(const int32_t *pairs, int32_t n_merges, int32_t n_special);
void lsot_bpe_free(void *h);
/* Encode n UTF-8 bytes. Writes <= n ids into out (cap >= n required);
 * returns the id count, or -1 if cap is too small. */
int32_t lsot_bpe_encode(void *h, const uint8_t *bytes, int32_t n,
                        int32_t *out, int32_t cap);

/* ---- CSV schema-inference scanner ---- */

/* Dtype codes (shared with sql/sqlite_backend.py). */
#define LSOT_CSV_STRING 0
#define LSOT_CSV_INT 1
#define LSOT_CSV_BIGINT 2
#define LSOT_CSV_DOUBLE 3
#define LSOT_CSV_TIMESTAMP 4

/* Infer per-column dtypes over all data rows (header skipped). Returns the
 * column count; -1 I/O error/empty, -2 row wider than header, -3 header
 * wider than max_cols. */
int32_t lsot_csv_scan(const char *path, int32_t *dtypes, int32_t max_cols,
                      int64_t *n_rows);

#ifdef __cplusplus
}
#endif

#endif /* LSOT_TORCH_TEXT_H */
