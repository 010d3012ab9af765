/*
 * JVM face of the port's CUDA engine: the natives of
 * com.nvidia.spark.rapids.tpu.PjrtEngine (src/main/java/.../PjrtEngine.java)
 * over the C ABI's srt_cuda_* functions (c_api.cpp), so a Spark executor
 * that follows that class's startup, PjrtEngine.init(...) and then kernel
 * calls, finds its natives in this library and routes the calls to the
 * card.
 *
 * It takes the place of the reference's src/main/cpp/jni/PjrtEngineJni.cpp,
 * which this library does not compile. The Java signatures are the same;
 * the behaviour differs where the engine does:
 *
 * - initNative: a null pluginPath throws the reference's message. There
 *   is no plugin to load, so the path is otherwise ignored. The options
 *   ("k=v;k=v") are read for one key, device=<n>, the CUDA device to start
 *   on (default 0); other keys are ignored, and a device value that is not
 *   a non-negative integer throws. A failed srt_cuda_init throws
 *   srt_last_error().
 * - availableNative, deviceCountNative and platformNameNative read
 *   srt_cuda_available, srt_cuda_device_count and srt_cuda_platform_name.
 * - registerProgramNative throws: the engine compiles its kernels into
 *   the library and keeps no StableHLO registry. Null arguments throw the
 *   reference's message first.
 * - programRegisteredNative returns false (a null name too, as in the
 *   reference).
 */
#include <jni.h>

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <string>

extern "C" {
int32_t srt_cuda_init(int32_t device);
int32_t srt_cuda_available();
int32_t srt_cuda_device_count();
const char* srt_cuda_platform_name();
const char* srt_last_error();
}

namespace {

void throw_java(JNIEnv* env, const char* msg) {
  jclass cls = env->FindClass("java/lang/RuntimeException");
  if (cls != nullptr) env->ThrowNew(cls, msg);
}

// RAII UTF chars (GetStringUTFChars must always be released).
struct utf_chars {
  JNIEnv* env;
  jstring s;
  const char* chars;
  utf_chars(JNIEnv* e, jstring str) : env(e), s(str) {
    chars = (s != nullptr) ? env->GetStringUTFChars(s, nullptr) : nullptr;
  }
  ~utf_chars() {
    if (chars != nullptr) env->ReleaseStringUTFChars(s, chars);
  }
};

// The device=<n> option of a "k=v;k=v" string: 0 when absent, -1 when its
// value is not a non-negative int32.
int32_t device_option(const std::string& options) {
  size_t at = 0;
  while (at <= options.size()) {
    size_t end = options.find(';', at);
    if (end == std::string::npos) end = options.size();
    const std::string kv = options.substr(at, end - at);
    const size_t eq = kv.find('=');
    if (eq != std::string::npos && kv.substr(0, eq) == "device") {
      const std::string v = kv.substr(eq + 1);
      if (v.empty() || v.find_first_not_of("0123456789") != std::string::npos) {
        return -1;
      }
      errno = 0;
      const long n = std::strtol(v.c_str(), nullptr, 10);
      return (errno != 0 || n > INT32_MAX) ? -1 : static_cast<int32_t>(n);
    }
    at = end + 1;
  }
  return 0;
}

}  // namespace

extern "C" {

JNIEXPORT void JNICALL Java_com_nvidia_spark_rapids_tpu_PjrtEngine_initNative(
    JNIEnv* env, jclass, jstring plugin_path, jstring options) {
  utf_chars path(env, plugin_path);
  utf_chars opts(env, options);
  if (path.chars == nullptr) {
    throw_java(env, "pluginPath must not be null");
    return;
  }
  const int32_t device = device_option(opts.chars ? opts.chars : "");
  if (device < 0) {
    throw_java(env, "the device option must be a non-negative integer");
    return;
  }
  if (srt_cuda_init(device) != 0) throw_java(env, srt_last_error());
}

JNIEXPORT jboolean JNICALL
Java_com_nvidia_spark_rapids_tpu_PjrtEngine_availableNative(JNIEnv*, jclass) {
  return srt_cuda_available() != 0 ? JNI_TRUE : JNI_FALSE;
}

JNIEXPORT jint JNICALL
Java_com_nvidia_spark_rapids_tpu_PjrtEngine_deviceCountNative(JNIEnv*,
                                                              jclass) {
  return srt_cuda_device_count();
}

JNIEXPORT jstring JNICALL
Java_com_nvidia_spark_rapids_tpu_PjrtEngine_platformNameNative(JNIEnv* env,
                                                               jclass) {
  return env->NewStringUTF(srt_cuda_platform_name());
}

JNIEXPORT void JNICALL
Java_com_nvidia_spark_rapids_tpu_PjrtEngine_registerProgramNative(
    JNIEnv* env, jclass, jstring name, jbyteArray mlir, jbyteArray) {
  utf_chars n(env, name);
  if (n.chars == nullptr || mlir == nullptr) {
    throw_java(env, "name and mlir must not be null");
    return;
  }
  throw_java(env,
             "the CUDA engine compiles its kernels into the library and "
             "keeps no StableHLO program registry");
}

JNIEXPORT jboolean JNICALL
Java_com_nvidia_spark_rapids_tpu_PjrtEngine_programRegisteredNative(
    JNIEnv*, jclass, jstring) {
  return JNI_FALSE;
}

}  // extern "C"
