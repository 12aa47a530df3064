/* nmftpu C ABI — the reference's flat compute API (SURVEY.md C1),
 * callable from any language that can dlopen a shared object. This copy
 * declares the library built from nmftpu_torch_capi.cc, which drives the
 * PyTorch/CUDA port (nmftpu_torch): the same functions and signatures as
 * native/nmftpu_capi.h.
 *
 * The library embeds CPython and drives the engine; the host
 * process needs no Python of its own. Typical sequence (mirrors
 * nmfgpu_initialize / nmfgpu_choose_gpu / nmfgpu_compute):
 *
 *   nmftpu_set_module_path("/path/to/repo");   // optional, else PYTHONPATH
 *   nmftpu_initialize();
 *   nmftpu_choose_device(0);
 *   NmftpuDescription d = {...};
 *   nmftpu_compute(&d);                         // fills out_w / out_h
 *   nmftpu_finalize();
 *
 * All functions return NMFTPU_SUCCESS (0) or an error code; details via
 * nmftpu_last_error(). Matrices are row-major float32. Exactly one of
 * dense_values or the CSR triple must be set.
 */

#ifndef NMFTPU_CAPI_H_
#define NMFTPU_CAPI_H_

#include <stdint.h>

/* ABI generation of NmftpuDescription. Version 2 appended
 * stats_callback/stats_user_data; a client compiled against an older
 * header MUST be rebuilt (the library reads the new trailing fields,
 * and a smaller caller-allocated struct would feed it garbage — there
 * is no runtime size negotiation in this flat ABI). Zero-initialize
 * the whole struct ({0}) so absent features stay off. */
#define NMFTPU_ABI_VERSION 2

#ifdef __cplusplus
extern "C" {
#endif

enum {
  NMFTPU_SUCCESS = 0,
  NMFTPU_ERROR_NOT_INITIALIZED = 1,
  NMFTPU_ERROR_INVALID_ARGUMENT = 2,
  NMFTPU_ERROR_NO_DEVICE = 3,
  NMFTPU_ERROR_PYTHON = 4,
};

/* Per-iteration statistics callback (reference C17 / §3.2: the stats
 * record {iteration, error, delta, elapsed ms} delivered to a user
 * callback at every convergence check, combined with the interrupt
 * poll). `error` is in the configured threshold metric; `delta` is its
 * absolute change since the previous check — the FIRST record's delta
 * is the drop from the initial (iteration-0) error, matching the
 * engine's convergence test. Return 0 to continue, nonzero to CANCEL
 * the run — cancellation takes effect at the next convergence check.
 * The callback may be invoked from a runtime-internal thread; it must
 * be thread-safe and must not call back into the nmftpu API. */
typedef int32_t (*NmftpuStatsCallback)(void* user_data, int32_t run,
                                       int32_t iteration, double error,
                                       double delta, double elapsed_ms);

typedef struct {
  /* problem */
  int32_t n_rows;
  int32_t n_cols;
  int32_t rank;
  /* algorithm selection (string enums as in nmftpu_torch.config) */
  const char* algorithm;       /* "mu" | "als" | "acls" | "ahcls" |
                                  "gdcls" | "nsnmf"; NULL -> "mu" */
  const char* objective;       /* "frobenius" | "kullback-leibler" |
                                  "itakura-saito" | "beta-divergence"
                                  (the latter reads `beta` below) */
  const char* init_method;     /* e.g. "all_random_values" */
  uint32_t seed;
  int32_t num_iterations;
  int32_t num_runs;
  int32_t check_interval;
  const char* threshold_type;  /* "frobenius" | "rmsd" */
  double threshold_value;
  /* algorithm knobs (ignored when 0) */
  double lambda_w, lambda_h, alpha_w, alpha_h, lambda_tik, theta;
  double alpha_confidence;
  double beta;                 /* beta-divergence exponent; read only
                                  when objective == "beta-divergence" */
  /* input: dense row-major ... */
  const float* dense_values;   /* n_rows * n_cols, or NULL */
  /* ... or CSR */
  const int64_t* csr_indptr;   /* n_rows + 1 */
  const int32_t* csr_indices;  /* nnz column indices */
  const float* csr_values;     /* nnz */
  int64_t nnz;
  /* warm start (init_method "copy_existing"); may be NULL */
  const float* initial_w;      /* n_rows * rank */
  const float* initial_h;      /* rank * n_cols */
  /* outputs, caller-allocated */
  float* out_w;                /* n_rows * rank */
  float* out_h;                /* rank * n_cols */
  /* results */
  double frobenius_error;
  double rmsd;
  int32_t iterations;
  int32_t converged;
  /* per-check stats callback + cancellation (may be NULL; see
   * NmftpuStatsCallback above) */
  NmftpuStatsCallback stats_callback;
  void* stats_user_data;
} NmftpuDescription;

/* Prepend a directory to the embedded interpreter's sys.path (call before
 * nmftpu_initialize; needed when nmftpu is not installed site-wide). */
int32_t nmftpu_set_module_path(const char* path);

int32_t nmftpu_initialize(void);
int32_t nmftpu_finalize(void);
const char* nmftpu_version(void);
int32_t nmftpu_device_count(void);
int32_t nmftpu_choose_device(int32_t index); /* -1 = most free memory */
int32_t nmftpu_compute(NmftpuDescription* desc);
const char* nmftpu_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* NMFTPU_CAPI_H_ */
