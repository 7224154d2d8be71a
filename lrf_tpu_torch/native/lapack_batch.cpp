// Batched symmetric eigendecomposition through LAPACK's ?syevd: the routine
// of scipy.linalg.cython_lapack (ssyevd, dsyevd), which the JAX package's
// CPU eigh calls too, handed in as function pointers.
//
// Each matrix is copied into a column-major buffer of its worker, run with
// jobz "V", uplo "L" and the workspace sizes jaxlib passes
// (lwork = 1 + 6n + 2n^2, liwork = 3 + 5n; ssytrd's blocking depends on
// them), and its eigenvectors are written back row-major with eigenvector j
// in column j, as scipy.linalg.eigh returns them. Every per-matrix `info`
// goes to `info`; the caller checks them.
//
// Instances. Worker threads take the batch's matrices one at a time from a
// shared counter, each holding one LAPACK instance alone, so that a worker
// whose core is busy with other work takes fewer of them instead of holding
// up the batch; which instance codes a matrix does not change its bits (see
// below). Instance 0 is
// the routines handed in (scipy's own OpenBLAS). OpenBLAS takes every
// level-2 and level-3 work buffer from one process-wide pool under one
// mutex, and ?syevd of a 64 x 64 matrix asks it a few hundred times, so
// threads that share one OpenBLAS take turns on that mutex (on an 8-core
// host, 8 workers took longer than one). So `lrf_lapack_instances` can also
// load private copies of the same OpenBLAS file with dlmopen, each in a link
// namespace of its own (own globals, own buffer pool), set to one OpenBLAS
// thread: the same machine code, so the same bits. Instance 0 keeps the
// process's thread count, so a call on one worker (`threads` == 1) runs
// exactly as scipy's own call would.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -o liblapackbatch.so
// lapack_batch.cpp -lpthread (lrf_tpu_torch/native/lapack_batch.py does
// this at first use).

#include <dlfcn.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <thread>
#include <vector>

namespace {

template <typename T>
using Syevd = void (*)(char*, char*, int*, T*, int*, T*, T*, int*, int*, int*, int*);
// A private copy's Fortran symbol, with gfortran's hidden lengths of the two
// CHARACTER*1 arguments.
template <typename T>
using FortranSyevd = void (*)(char*, char*, int*, T*, int*, T*, T*, int*, int*, int*, int*, size_t, size_t);
using SetThreads = void (*)(int);

constexpr int kBadSize = -1;
constexpr int kFailed = -2;
constexpr int kNoInstances = -3;

struct Instance {
  void* s;  // ssyevd
  void* d;  // dsyevd
  bool fortran;  // a private copy's Fortran symbols (hidden lengths passed)
};

// The process's instances; `idle` holds those no worker holds, instance 0
// at the bottom, so private copies are taken first.
struct Pool {
  std::mutex m;
  std::condition_variable cv;
  std::vector<Instance> all;
  std::vector<int> idle;

  int acquire() {
    std::unique_lock<std::mutex> lock(m);
    cv.wait(lock, [this] { return !idle.empty(); });
    int k = idle.back();
    idle.pop_back();
    return k;
  }

  void release(int k) {
    {
      std::lock_guard<std::mutex> lock(m);
      idle.push_back(k);
    }
    cv.notify_one();
  }
};

Pool pool;

// A private copy of the OpenBLAS file at `path`, on one thread, or false.
bool load_copy(const char* path, Instance* out) {
  void* h = dlmopen(LM_ID_NEWLM, path, RTLD_NOW | RTLD_LOCAL);
  if (h == nullptr) return false;
  void* s = dlsym(h, "scipy_ssyevd_");
  void* d = dlsym(h, "scipy_dsyevd_");
  auto set = reinterpret_cast<SetThreads>(dlsym(h, "scipy_openblas_set_num_threads"));
  if (s == nullptr || d == nullptr || set == nullptr) {
    dlclose(h);
    return false;
  }
  set(1);
  // a copy runs on its caller's thread only: stop the thread pool its
  // OpenBLAS started at load
  if (auto stop = reinterpret_cast<void (*)()>(dlsym(h, "blas_thread_shutdown_"))) stop();
  *out = Instance{s, d, true};
  return true;
}

template <typename T>
void call(const Instance& inst, char* jobz, char* uplo, int* n, T* a, int* lda, T* w, T* work, int* lwork,
          int* iwork, int* liwork, int* info) {
  void* fn = sizeof(T) == sizeof(float) ? inst.s : inst.d;
  if (inst.fortran)
    reinterpret_cast<FortranSyevd<T>>(fn)(jobz, uplo, n, a, lda, w, work, lwork, iwork, liwork, info, 1, 1);
  else
    reinterpret_cast<Syevd<T>>(fn)(jobz, uplo, n, a, lda, w, work, lwork, iwork, liwork, info);
}

// The matrices whose indices `next()` hands out, until it gives `count`.
template <typename T, typename Next>
void run_items(const Instance& inst, const T* a, T* w, T* v, int n, int64_t count, Next next, int32_t* info) {
  const int64_t nn = static_cast<int64_t>(n) * n;
  int order = n, lda = n;
  int lwork = 1 + 6 * n + 2 * n * n, liwork = 3 + 5 * n;
  char jobz = 'V', uplo = 'L';
  std::vector<T> buf(nn), work(lwork);
  std::vector<int> iwork(liwork);
  for (int64_t i = next(); i < count; i = next()) {
    const T* src = a + i * nn;
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < n; ++c) buf[r + static_cast<int64_t>(c) * n] = src[static_cast<int64_t>(r) * n + c];
    int status = 0;
    call<T>(inst, &jobz, &uplo, &order, buf.data(), &lda, w + i * n, work.data(), &lwork, iwork.data(), &liwork,
            &status);
    info[i] = status;
    T* dst = v + i * nn;
    for (int r = 0; r < n; ++r)
      for (int j = 0; j < n; ++j) dst[static_cast<int64_t>(r) * n + j] = buf[r + static_cast<int64_t>(j) * n];
  }
}

template <typename T>
int syevd_batch(const T* a, T* w, T* v, int64_t count, int64_t n, int32_t threads, int32_t* info) {
  // lwork = 1 + 6n + 2n^2 must fit LAPACK's 32-bit int
  if (count < 0 || n < 1 || n > 32000) return kBadSize;
  Instance first;
  int64_t instances;
  {
    std::lock_guard<std::mutex> lock(pool.m);
    if (pool.all.empty()) return kNoInstances;
    first = pool.all[0];
    instances = static_cast<int64_t>(pool.all.size());
  }
  if (count == 0) return 0;
  const int order = static_cast<int>(n);
  int64_t workers = std::min(threads > 0 ? static_cast<int64_t>(threads) : instances, count);
  if (workers <= 1) {
    int64_t i = 0;
    try {
      run_items<T>(first, a, w, v, order, count, [&i] { return i++; }, info);
    } catch (...) {
      return kFailed;
    }
    return 0;
  }
  std::vector<char> failed(workers, 0);
  std::atomic<int64_t> taken{0};
  const auto next = [&taken] { return taken.fetch_add(1, std::memory_order_relaxed); };
  std::vector<std::thread> team;
  bool spawned = true;
  try {
    team.reserve(workers);
    for (int64_t k = 0; k < workers; ++k) {
      team.emplace_back([&, k] {
        int held = pool.acquire();
        try {
          run_items<T>(pool.all[held], a, w, v, order, count, next, info);
        } catch (...) {
          failed[k] = 1;
        }
        pool.release(held);
      });
    }
  } catch (...) {
    spawned = false;  // join the workers that did start, then report
  }
  for (auto& t : team) t.join();
  if (!spawned || std::find(failed.begin(), failed.end(), 1) != failed.end()) return kFailed;
  return 0;
}

}  // namespace

extern "C" {

// Sets instance 0 to (`s`, `d`) and, where `anchor` is an address inside
// scipy's bundled OpenBLAS, loads private copies of that file until there
// are `want` instances or a copy fails to load. Only the first call loads;
// every call returns the number of instances.
int lrf_lapack_instances(void* s, void* d, void* anchor, int want) {
  std::lock_guard<std::mutex> lock(pool.m);
  if (!pool.all.empty()) return static_cast<int>(pool.all.size());
  if (s == nullptr || d == nullptr) return 0;
  pool.all.push_back(Instance{s, d, false});
  Dl_info where;
  if (anchor != nullptr && dladdr(anchor, &where) != 0 && where.dli_fname != nullptr) {
    Instance copy;
    while (static_cast<int>(pool.all.size()) < want && load_copy(where.dli_fname, &copy)) pool.all.push_back(copy);
  }
  for (int k = 0; k < static_cast<int>(pool.all.size()); ++k) pool.idle.push_back(k);
  return static_cast<int>(pool.all.size());
}

int lrf_syevd_batch_f32(const float* a, float* w, float* v, int64_t count, int64_t n, int32_t threads,
                        int32_t* info) {
  return syevd_batch<float>(a, w, v, count, n, threads, info);
}

int lrf_syevd_batch_f64(const double* a, double* w, double* v, int64_t count, int64_t n, int32_t threads,
                        int32_t* info) {
  return syevd_batch<double>(a, w, v, count, n, threads, info);
}

}  // extern "C"
